"""Self-supervised Conformer pretraining (masked contrastive), the encoder
and preprocessor taken from an ASR config.

    python -m conformer_nemo_tpu_torch.scripts.ssl_pretrain \
        --config configs/conformer_ctc_bpe.yaml [--device cpu] \
        model.train_ds.manifest_filepath=unlabeled.json \
        trainer.max_steps=100000 [--quantized-targets] --out ssl.cntpu

The archive (`kind: ssl`) restores in either package
(`SpeechSSLModel.restore_weights`).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from conformer_nemo_tpu_torch.scripts.common import add_device_arg, parse_overrides


def main(argv: Optional[Sequence[str]] = None):
    """-> (model, fit result)."""
    overrides, leftover = parse_overrides(sys.argv[1:] if argv is None else list(argv))
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/conformer_ctc_bpe.yaml",
                    help="encoder/preprocessor come from this ASR config")
    ap.add_argument("--out", default="ssl_pretrained.cntpu")
    ap.add_argument("--quantized-targets", action="store_true")
    ap.add_argument("--patch-size", type=int, default=48)
    ap.add_argument("--mask-patches", type=int, default=10)
    add_device_arg(ap)
    args = ap.parse_args(leftover)

    import torch

    from conformer_nemo_tpu_torch.api_ssl import SpeechSSLModel
    from conformer_nemo_tpu_torch.config.loader import (
        build_encoder_config,
        build_preprocessor_config,
        load_config,
    )
    from conformer_nemo_tpu_torch.ops.contrastive_loss import ContrastiveLossConfig

    cfg = load_config(args.config, overrides)
    m = cfg["model"]
    mel = build_preprocessor_config(m.get("preprocessor", {}))
    enc = build_encoder_config(m.get("encoder", {}), dtype=torch.bfloat16)
    tr = cfg.get("trainer", {})
    lr = (m.get("optim") or {}).get("lr", 1e-3)
    model = SpeechSSLModel(
        encoder=enc, mel=mel,
        loss=ContrastiveLossConfig(in_dim=mel.features, combine_time_steps=enc.subsampling_factor,
                                   quantized_targets=args.quantized_targets),
        patch_size=args.patch_size, mask_patches=args.mask_patches, device=args.device)
    result = model.fit(
        m["train_ds"]["manifest_filepath"],
        max_steps=int(tr.get("max_steps") or 1000),
        batch_size=int(m["train_ds"].get("batch_size", 8)),
        lr=float(lr) if isinstance(lr, (int, float)) else 1e-3,
        log_every_n_steps=int(tr.get("log_every_n_steps", 20)))
    print(f"pretrained {result['steps']} steps; "
          f"last={result['history'][-1] if result['history'] else None}", flush=True)
    model.save_portable(args.out)
    print(f"portable: {args.out}", flush=True)
    return model, result


if __name__ == "__main__":
    main()
