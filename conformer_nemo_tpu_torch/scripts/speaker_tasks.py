"""Speaker recognition and verification.

    # train a speaker model
    python -m conformer_nemo_tpu_torch.scripts.speaker_tasks train \
        --train-manifest spk.json --max-steps 5000 --out spk.cntpu [--device cpu]
    # are two files the same speaker?
    python -m conformer_nemo_tpu_torch.scripts.speaker_tasks verify --model spk.cntpu a.wav b.wav
    # print each file's embedding
    python -m conformer_nemo_tpu_torch.scripts.speaker_tasks embed --model spk.cntpu a.wav
    # diarize a session: RTTM to stdout, or appended to --rttm-out
    python -m conformer_nemo_tpu_torch.scripts.speaker_tasks diarize --model spk.cntpu \
        session.wav [--num-speakers 2] [--rttm-out out.rttm] [--device cpu]
    # cumulative DER of hypothesis RTTMs against references (host only)
    python -m conformer_nemo_tpu_torch.scripts.speaker_tasks score \
        --ref-rttm ref.rttm --hyp-rttm out.rttm [--collar 0.25]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from conformer_nemo_tpu_torch.scripts.common import add_device_arg


def main(argv: Optional[Sequence[str]] = None):
    """-> (model, the mode's result: the fit result, the verdict,
    {path: embedding}, the RTTM text, or (model None) the printed score)."""
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
    ap.add_argument("--num-speakers", type=int, default=None)
    ap.add_argument("--window", type=float, default=1.5)
    ap.add_argument("--shift", type=float, default=0.75)
    ap.add_argument("--rttm-out", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ref-rttm", nargs="*", default=[],
                    help="score mode: reference RTTMs (paired with --hyp-rttm)")
    ap.add_argument("--hyp-rttm", nargs="*", default=[])
    ap.add_argument("--collar", type=float, default=0.25)
    ap.add_argument("--ignore-overlap", action="store_true", default=True)
    add_device_arg(ap)
    # intermixed: the audio paths may follow options (`verify --model m a.wav b.wav`)
    args = ap.parse_intermixed_args(sys.argv[1:] if argv is None else list(argv))
    if args.mode == "train" and not args.train_manifest:
        ap.error("train mode requires --train-manifest")
    if args.mode not in ("train", "score") and not args.model:
        ap.error(f"{args.mode} mode requires --model")

    if args.mode == "score":
        import json

        from conformer_nemo_tpu_torch.decode.der import score_rttm_files

        if len(args.ref_rttm) != len(args.hyp_rttm) or not args.ref_rttm:
            raise SystemExit("score mode needs matching --ref-rttm/--hyp-rttm lists")
        res = score_rttm_files(list(zip(args.ref_rttm, args.hyp_rttm)), collar=args.collar,
                               ignore_overlap=args.ignore_overlap)
        printed = {k: round(v, 4) for k, v in res.items()}
        print(json.dumps(printed), flush=True)
        return None, printed

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
    if args.mode == "diarize":
        from conformer_nemo_tpu_torch.decode.diarization import ClusteringDiarizer, to_rttm

        diar = ClusteringDiarizer(model, window=args.window, shift=args.shift)
        texts = []
        for path in args.audio:
            turns = diar.diarize(path, oracle_num_speakers=args.num_speakers)
            rttm = to_rttm(turns, path.rsplit("/", 1)[-1].rsplit(".", 1)[0])
            texts.append(rttm)
            if args.rttm_out:
                with open(args.rttm_out, "a", encoding="utf-8") as f:
                    f.write(rttm)
                print(f"wrote {len(turns)} turns -> {args.rttm_out}", flush=True)
            else:
                print(rttm, end="", flush=True)
        return model, "".join(texts)
    embs = {}
    for path in args.audio:
        embs[path] = model.get_embedding(path)
        print(path, " ".join(f"{x:.5f}" for x in embs[path]), flush=True)
    return model, embs


if __name__ == "__main__":
    main()
