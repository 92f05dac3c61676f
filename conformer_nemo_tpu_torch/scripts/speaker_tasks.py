"""Speaker recognition and verification.

    # train a speaker model
    python -m conformer_nemo_tpu_torch.scripts.speaker_tasks train \
        --train-manifest spk.json --max-steps 5000 --out spk.cntpu [--device cpu]
    # are two files the same speaker?
    python -m conformer_nemo_tpu_torch.scripts.speaker_tasks verify --model spk.cntpu a.wav b.wav
    # print each file's embedding
    python -m conformer_nemo_tpu_torch.scripts.speaker_tasks embed --model spk.cntpu a.wav

The `diarize` and `score` modes need the diarization modules, which are not
ported yet (ROADMAP.md queue 1 item 11 slice 3): they raise
NotImplementedError.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from conformer_nemo_tpu_torch.scripts.common import add_device_arg

NOT_PORTED = ("speaker_tasks {mode}: diarization (decode/diarization.py, decode/der.py) is "
              "not ported yet; see ROADMAP.md queue 1 item 11 slice 3")


def main(argv: Optional[Sequence[str]] = None):
    """-> (model, the mode's result: the fit result, the verdict, or
    {path: embedding})."""
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["train", "verify", "diarize", "embed", "score"])
    ap.add_argument("audio", nargs="*", default=[])
    ap.add_argument("--model")
    ap.add_argument("--train-manifest")
    ap.add_argument("--val-manifest")
    ap.add_argument("--labels", nargs="*", default=None)
    ap.add_argument("--max-steps", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--fixed-seconds", type=float, default=3.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--features", type=int, default=80)
    ap.add_argument("--threshold", type=float, default=0.7)
    ap.add_argument("--out", default=None)
    add_device_arg(ap)
    # intermixed: the audio paths may follow options (`verify --model m a.wav b.wav`)
    args = ap.parse_intermixed_args(sys.argv[1:] if argv is None else list(argv))
    if args.mode in ("diarize", "score"):
        raise NotImplementedError(NOT_PORTED.format(mode=args.mode))
    if args.mode == "train" and not args.train_manifest:
        ap.error("train mode requires --train-manifest")
    if args.mode != "train" and not args.model:
        ap.error(f"{args.mode} mode requires --model")

    from conformer_nemo_tpu_torch.api_label import SpeakerLabelModel
    from conformer_nemo_tpu_torch.audio.features import MelFeatureConfig

    if args.mode == "train":
        labels = args.labels
        if not labels:
            from conformer_nemo_tpu_torch.data.audio_to_label import (
                extract_labels,
                read_label_manifest,
            )

            labels = extract_labels(read_label_manifest(args.train_manifest))
            print(f"extracted {len(labels)} speakers", flush=True)
        model = SpeakerLabelModel(labels=labels, mel=MelFeatureConfig(features=args.features),
                                  device=args.device)
        result = model.fit(args.train_manifest, args.val_manifest, max_steps=args.max_steps,
                           batch_size=args.batch_size, fixed_seconds=args.fixed_seconds,
                           lr=args.lr)
        print(f"trained {result['steps']} steps; "
              f"last={result['history'][-1] if result['history'] else None}", flush=True)
        if "val" in result:
            print(f"val: {result['val']}", flush=True)
        if args.out:
            model.save_portable(args.out)
            print(f"portable: {args.out}", flush=True)
        return model, result

    model = SpeakerLabelModel.restore_portable(args.model, device=args.device)
    if args.mode == "verify":
        a, b = args.audio[:2]
        same = model.verify_speakers(a, b, threshold=args.threshold)
        print("same speaker" if same else "different speakers", flush=True)
        return model, same
    embs = {}
    for path in args.audio:
        embs[path] = model.get_embedding(path)
        print(path, " ".join(f"{x:.5f}" for x in embs[path]), flush=True)
    return model, embs


if __name__ == "__main__":
    main()
