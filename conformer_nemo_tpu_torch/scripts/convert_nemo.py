"""Convert a NeMo checkpoint into a portable `.cntpu` archive (port of
scripts/convert_nemo.py; NeMo's `Model.restore_from('x.nemo')`).

    python -m conformer_nemo_tpu_torch.scripts.convert_nemo model.nemo out.cntpu [--device cpu]
    python -m conformer_nemo_tpu_torch.scripts.convert_nemo model.ckpt out.cntpu \
        --config model_config.yaml [--model-type auto|ctc|rnnt]

A Conformer CTC or RNN-T checkpoint (the type read from its `joint.*`
entries unless given) is loaded into the port's model on the device (CUDA
unless --device cpu), and written as a `.cntpu` with the JAX script's
config and artifacts, so that either package's `restore_portable` serves
it: the tokenizer files under their plain names (`tokenizer.model`,
`vocab.txt`, ...), or an aggregate tokenizer's SentencePiece models as
`tokenizer_<lang>.model` with each language's `model_file` pointing there.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
from typing import Optional, Sequence

import yaml

from conformer_nemo_tpu_torch.scripts.common import add_device_arg

TOKENIZER_FILES = ("tokenizer.model", "tokenizer.vocab", "vocab.txt", "tokenizer.json",
                   "merges.txt", "vocab.json")


def detect_model_type(sd: dict) -> str:
    return "rnnt" if any(k.startswith("joint.") for k in sd) else "ctc"


def _aggregate_artifacts(tok_cfg: dict, artifacts: dict, tmp: str) -> tuple:
    """An aggregate tokenizer's per-language SentencePiece models (NeMo
    registers each as `model_path: nemo:<md5>_tokenizer.model`) -> (the
    converted config's tokenizer, {"tokenizer_<lang>.model": copied path})."""
    langs, out = {}, {}
    for lang, sub in (tok_cfg.get("langs") or {}).items():
        sub = dict(sub or {})
        if sub.get("type", "bpe") != "bpe":
            # NeMo registers a wpe sub-tokenizer by its vocabulary files, which
            # the model_path rule below would load as a SentencePiece model
            raise NotImplementedError(
                f"multilang archive: sub-tokenizer type {sub.get('type')!r} for lang "
                f"{lang!r} is not supported by the converter (only 'bpe'/SentencePiece "
                "sub-tokenizers; agg+wpe archives register vocab artifacts the converter "
                "does not carry)")
        member = str(sub.get("model_path") or sub.get("dir") or "")
        if member.startswith("nemo:"):
            member = member[len("nemo:"):]
        src = artifacts.get(os.path.basename(member)) or artifacts.get(f"{lang}_tokenizer.model")
        if src is None:
            raise FileNotFoundError(f"multilang archive: no tokenizer artifact for lang "
                                    f"{lang!r} (looked for {os.path.basename(member)!r})")
        base = f"tokenizer_{lang}.model"
        out[base] = os.path.join(tmp, base)
        shutil.copy(src, out[base])
        langs[lang] = {"type": sub.get("type", "bpe"), "model_file": base}
    return {"type": "agg", "langs": langs}, out


def convert(in_path: str, out_path: str, config_path: Optional[str] = None,
            model_type: str = "auto", device=None) -> str:
    """`.nemo` (or a bare torch `.ckpt` with its `config_path`) -> `.cntpu`
    at out_path. -> the model type, "ctc" or "rnnt"."""
    import torch

    from conformer_nemo_tpu_torch.config.loader import (
        build_ctc_model_config,
        build_rnnt_model_config,
    )
    from conformer_nemo_tpu_torch.convert.jax_params import (
        ctc_variables_to_jax,
        rnnt_variables_to_jax,
    )
    from conformer_nemo_tpu_torch.convert.nemo_archive import (
        load_nemo_archive,
        load_torch_weights,
        strip_targets,
    )
    from conformer_nemo_tpu_torch.convert.nemo_state import nemo_state_dict
    from conformer_nemo_tpu_torch.device import resolve_device
    from conformer_nemo_tpu_torch.models.ctc_model import CTCModel
    from conformer_nemo_tpu_torch.models.rnnt import RNNTModel
    from conformer_nemo_tpu_torch.train.checkpoint import save_portable

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="cntpu_conv_") as tmp:
        artifacts = {}
        if in_path.endswith(".nemo") or config_path is None:
            config, sd, artifacts = load_nemo_archive(in_path, os.path.join(tmp, "nemo"))
        else:
            sd = load_torch_weights(in_path)
            with open(config_path, encoding="utf-8") as f:
                config = yaml.safe_load(f)
        m = strip_targets(config)
        if "model" in m:  # a Lightning config wraps the model section
            m = m["model"]
        if model_type == "auto":
            model_type = detect_model_type(sd)
        if model_type == "ctc":
            vocab = int(sd["decoder.decoder_layers.0.weight"].shape[0]) - 1
            cfg = build_ctc_model_config({"model": m}, vocab_size=vocab, dtype=torch.float32)
            model, to_jax, mcfg = CTCModel(cfg), ctc_variables_to_jax, cfg
        else:
            vocab = int(sd["decoder.prediction.embed.weight"].shape[0]) - 1
            mcfg = build_rnnt_model_config({"model": m}, vocab_size=vocab,
                                           dtype=torch.float32).model
            model, to_jax = RNNTModel(mcfg), rnnt_variables_to_jax
        state, dropped = nemo_state_dict(sd, model)
        model = model.to(dev)
        model.load_state_dict(state, strict=True)
        if dropped:
            print(f"convert_nemo: dropped {len(dropped)} entries the model has no place for: "
                  f"{dropped[:6]}{' ...' if len(dropped) > 6 else ''}", flush=True)

        tok_cfg = m.get("tokenizer") or {}
        if tok_cfg.get("type") == "agg":
            m["tokenizer"], art_out = _aggregate_artifacts(tok_cfg, artifacts, tmp)
        else:
            art_out = {}
            for want in TOKENIZER_FILES:
                if want in artifacts:
                    art_out[want] = os.path.join(tmp, want)
                    shutil.copy(artifacts[want], art_out[want])
        save_portable(out_path, {"model": m}, to_jax(model.state_dict(), mcfg), art_out or None)
    return model_type


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input", help=".nemo archive or torch .ckpt")
    ap.add_argument("output", help="output .cntpu path")
    ap.add_argument("--config", default=None,
                    help="model_config.yaml (required for bare .ckpt inputs)")
    ap.add_argument("--model-type", default="auto", choices=["auto", "ctc", "rnnt"])
    add_device_arg(ap)
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    mt = convert(args.input, args.output, args.config, args.model_type, device=args.device)
    print(f"converted {args.input} ({mt}) -> {args.output}", flush=True)
    return mt


if __name__ == "__main__":
    main()
